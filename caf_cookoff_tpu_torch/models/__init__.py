"""CAF engines: the filterbank and the segmented (Stein) engine."""
