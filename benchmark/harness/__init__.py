"""The benchmark's shared machinery: environment, seeded inputs, tracing
and the result line.  Imports nothing of the program at module level."""
