"""The benchmark's plain reference: the port's decoder models, their
training step and their serving written again in plain PyTorch, computed
in float32 (or, for the precision control, with every product's operands
rounded to float8).  It imports nothing of the program."""
