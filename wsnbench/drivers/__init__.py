"""Drivers: one per kind of traffic, each read by name from a traffic
mix's ``driver`` key.  A driver makes the cell's data from the seed, sets
up and warms the program, runs the measured window and compares what the
window produced with the plain reference."""
