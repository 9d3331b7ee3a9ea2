"""The plain reference the served bits are judged against (NumPy, and
PyTorch for the lower-precision control); it imports nothing of the
program and takes nothing the program made."""
