"""How the port's model is built for each configuration, and what is counted
from its published shapes (FLOPs, the fused kernels' calls)."""
