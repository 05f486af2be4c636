"""Device compute kernels: ranks, interval index, interval join, coverage ops."""
