"""Plain PyTorch reference of the configurations the benchmark runs: a frozen
copy of the port's model, loss and step code with the five kernels as their
plain versions (``ops.py``), one process, float32.  It imports nothing of
``fm3dgan_torch``; ``trainer.py`` follows the trainers' iterations."""
