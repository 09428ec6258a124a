"""Serving runtime of the port: connectors, the frame batcher and the
recognizer service. Importing this package starts nothing."""
