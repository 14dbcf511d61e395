"""Network topologies with host-side numpy routing."""
