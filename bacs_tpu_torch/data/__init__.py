"""Data: sources, continual scenarios, transforms and the DataModule."""
