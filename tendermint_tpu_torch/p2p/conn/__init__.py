"""Connection layer: authenticated encryption + channel multiplexing."""
