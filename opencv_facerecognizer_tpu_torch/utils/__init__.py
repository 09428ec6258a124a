"""Host-side helpers of the port: device resolution, parameter import
from the JAX package's flax layout, checkpoints, datasets, validation,
verification, plots, stage timing and serving metrics."""
