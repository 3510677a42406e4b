"""Host utilities of the port: page image reading and stage timing."""
