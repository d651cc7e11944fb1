"""ScanNet scene chunking and synthetic scenes (numpy only)."""
