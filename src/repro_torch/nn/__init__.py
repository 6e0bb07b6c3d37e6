"""The LM substrate of the port: the dense family's serving path."""
