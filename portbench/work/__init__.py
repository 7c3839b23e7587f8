"""Frozen work counts of the benchmark: the card's peaks, each kernel's
operations and bytes, and a model's FLOPs per token.  Copies, not imports:
the program may change its own counts, the yardstick does not move."""
