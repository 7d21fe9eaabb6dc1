"""Device ops of the port: letterbox, NMS, sparse towers, rotation, rasterizer."""
