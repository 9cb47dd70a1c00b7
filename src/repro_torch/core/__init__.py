"""int8 quantization arithmetic and the DSC block disciplines (torch)."""
