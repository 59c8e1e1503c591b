"""Operation and byte counts, one file each, fixed from shapes: LAPACK's
operation counts of the routines a call runs, and each kernel's
operations and the bytes it must move (each input byte read once, each
output byte written once)."""
