"""Paper-§5 scheduling (copied from the reference) and the Hopper tiling."""
