"""Plain references that decide ``correct``: plain PyTorch and NumPy, in
float64, importing nothing of the program they judge.  Each module takes
the inputs the benchmark generated and works out the answer again."""
