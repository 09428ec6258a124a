"""Command-line entry points of the port (``ocvf-recognize-torch``)."""
