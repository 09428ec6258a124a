"""Models of the serving path: the CNN face detector and embedder."""
