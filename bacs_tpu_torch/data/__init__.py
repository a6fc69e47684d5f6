"""Input transforms."""
