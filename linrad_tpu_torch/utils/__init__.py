"""Scan and segmented-reduction helpers of the port."""
