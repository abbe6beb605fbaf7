"""The benchmark's plain reference of the RAD-NeRF head and torso."""
