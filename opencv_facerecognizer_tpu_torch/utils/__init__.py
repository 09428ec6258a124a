"""Host-side helpers of the port: device resolution, parameter import
from the JAX package's flax layout, and serving metrics."""
