"""Host-side data code of the port (numpy only): batches, the packed wire and the ScanNet store;
ModelNet and ShapeNet-part datasets and their augmentations."""
