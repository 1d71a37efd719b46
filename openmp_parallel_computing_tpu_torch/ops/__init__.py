"""Image ops of the PyTorch port: plain twins and the perception kernel."""
