"""Process groups and meshes of the port (counterpart of nemo_tpu/parallel/)."""
