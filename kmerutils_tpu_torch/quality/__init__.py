"""Quality storage (3-bit Phred remap in a wavelet matrix) and its server."""
