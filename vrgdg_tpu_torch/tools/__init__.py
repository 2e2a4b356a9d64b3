"""Command-line probes of the port's kernels on the card."""
