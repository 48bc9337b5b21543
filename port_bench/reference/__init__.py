"""The plain reference that decides `correct`: plain PyTorch, and for the
physics an f64 C++ step (native/, bound by oracle.py) written apart from
the port's engine. It imports nothing of the program
(learning_to_adapt_torch) nor of the JAX package, and takes nothing that
the program made. The benchmark hands it the same inputs it handed the
program (weights, data, seeds) and the program's outputs, which it reads
only to judge them."""
