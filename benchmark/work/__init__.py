"""Files of the benchmark found by name; see benchmark/README.md."""
