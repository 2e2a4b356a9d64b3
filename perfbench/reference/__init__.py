"""The plain reference the benchmark judges the program's frames by.

Plain PyTorch and NumPy, written from the published descriptions of each
stage (the pack's nodes, CIELAB with kornia's constants, Philox4x32-10,
OpenCV's Lanczos-4).  It imports nothing of the program and takes nothing
the program made: it parses the ``.cube`` file, works out the LUT lattice,
the colour-match statistics and the resampling weights again, and reads
only the host frames the benchmark made.  It computes in float64; the
control computes the same in the precision below the program's.
"""
