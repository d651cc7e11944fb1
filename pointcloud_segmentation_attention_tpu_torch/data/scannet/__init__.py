"""ScanNet data of the port (numpy only): the scene store and splits, label
maps, chunkers, precompute and replay, and the packed-record store."""
