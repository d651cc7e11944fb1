"""Operation and byte counts, and the chip's peaks."""
