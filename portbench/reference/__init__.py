"""The plain reference the benchmark holds the program to.

`sketch` computes HyperLogLog registers of FASTA genomes from the
definitions, `estimators` Ertl's MLE and joint MLE in any float dtype,
`compare` what a dist job should write and how far the job's files lie
from it.  Plain PyTorch and NumPy: nothing here imports the program, the
JAX package or JAX, and nothing takes a value the program made.
"""
