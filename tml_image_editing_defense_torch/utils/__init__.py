"""Device and numerics, metrics logging, visualization."""
