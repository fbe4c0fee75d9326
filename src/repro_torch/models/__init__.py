"""Models of the port: the video DiT and its shared layers."""
