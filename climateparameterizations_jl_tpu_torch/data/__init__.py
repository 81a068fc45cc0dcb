"""Data containers, the simulation catalog and the synthetic LES stand-ins."""
