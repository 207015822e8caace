"""Model definition: config, layers, paged attention, network, bridge."""
