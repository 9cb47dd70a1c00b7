"""Networks built from the DSC blocks."""
