"""Launch helpers (port of `repro.launch`): the device meshes."""
