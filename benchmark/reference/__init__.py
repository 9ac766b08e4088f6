"""Plain references the benchmark judges the program's outputs against.

Torch and numpy only: nothing here imports the program or the JAX
package, and nothing takes a table or a weight that the program made.
"""
