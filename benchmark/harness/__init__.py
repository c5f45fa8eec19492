"""The benchmark's own machinery: finding a cell's files, making weights and
inputs from the seed, reading the trace, and printing the result line."""
