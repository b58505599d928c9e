"""Model/system configurations of the port."""
