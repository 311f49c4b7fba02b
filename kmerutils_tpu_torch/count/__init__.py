"""Whole-file k-mer counting: the streaming count table and host spill."""
