"""The plain references the benchmark holds the program to: plain PyTorch
from the published equations, importing nothing of the program."""
