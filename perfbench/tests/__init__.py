"""CPU tests of the benchmark (``cuda``-marked ones need a card)."""
