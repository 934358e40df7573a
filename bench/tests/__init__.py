"""CPU tests of the benchmark at tiny sizes; the card-only ones carry the cuda marker."""
