"""Operation and byte counts of the program's kernels, and the peaks they
are held against: a kernel's least time on the chip is the larger of its
bytes over the memory rate and its operations over the compute rate."""
