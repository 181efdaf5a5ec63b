"""Traffic mixes (one JSON file each) and their generator."""
