"""Traffic: the one generator (generate.py) and its parameter files."""
