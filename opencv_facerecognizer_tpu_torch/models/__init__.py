"""Models: the CNN face detector, embedder and cascade gate of the serving
path, and the plugin boundary of the classic models (features,
classifiers, operators, ``PredictableModel``)."""
