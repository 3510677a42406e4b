"""The recognizer model of the port."""
