"""Training data: datafile dataset, batch loader, mixer, synthetic corpus."""
