"""Signal ops of the port: windows, conditioning, trigger extraction."""
