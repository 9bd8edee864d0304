"""Frozen copy of the port's `w8pt_ba` pose stage (plain PyTorch)."""
