"""Host-side utilities of the port: registry, options, logging, image I/O, colour."""
