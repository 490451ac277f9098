"""The dense decoder of the port: layers, transformer, model bundle."""
