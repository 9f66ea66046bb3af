"""Event generators, one module per configuration kind, found by the
``generator`` key of a configuration file.  Each module defines
``columns(config, seed) -> (columns, jagged)``: the flat and jagged
columns of one file (NumPy arrays) and the jagged branches' counts."""
