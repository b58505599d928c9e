"""MD-side helpers of the port (neighbour lists so far)."""
