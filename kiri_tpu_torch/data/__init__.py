"""Host-side text data helpers of the port."""
