"""Host-side data code of the port (numpy only): batches, the packed wire and the ScanNet store;
ModelNet, ShapeNet-part and S3DIS datasets and their augmentations."""
