"""Plain PyTorch ops (the reference math the kernels are held to)."""
