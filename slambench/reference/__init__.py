"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
independent of the program under test."""
