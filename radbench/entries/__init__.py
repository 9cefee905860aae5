"""One module a configuration entry: setup(config, workload, seed, device, root)."""
