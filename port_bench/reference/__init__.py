"""The plain reference: float32 PyTorch and numpy, importing nothing of the program."""
