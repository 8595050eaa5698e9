"""The PyTorch and CUDA port's benchmark: ``python3 -m portbench.run``."""
