"""Plain references that decide ``correct``: the products in float64 with
plain PyTorch (``products``), their one-bf16-pass controls, and the
comparisons of an answer with them (``compare``).  Nothing here imports
the port or anything it made: operands are drawn again from the seed."""
