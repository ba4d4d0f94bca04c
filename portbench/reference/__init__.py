"""The plain reference of what the benchmark runs: plain torch, imports
nothing of the program under test."""
