"""The plain reference: the benchmark's own geometry, frames and ground
truth, and the comparison that decides `correct`. Plain NumPy and PyTorch;
imports nothing of the program, of JAX or of the JAX package."""
