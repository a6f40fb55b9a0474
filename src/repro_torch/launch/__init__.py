"""Launch helpers (port of `repro.launch`): the device meshes (a fake
world too), the step cost count, the dry run and its reports."""
