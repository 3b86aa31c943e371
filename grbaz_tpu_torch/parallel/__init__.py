"""Many channels of one stream on one card."""
