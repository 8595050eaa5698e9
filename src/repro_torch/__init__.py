"""PyTorch / CUDA port of the STEP serving system (``repro`` is the JAX
reference). It keeps ``repro``'s module layout and names; it imports
torch and numpy, never jax and never ``repro``."""
