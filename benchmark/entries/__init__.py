"""What the measured window of a cell drives, one module an entry."""
