"""Tools of the port: the trainer configuration, metric logging, and measurement scripts that run on the card."""
