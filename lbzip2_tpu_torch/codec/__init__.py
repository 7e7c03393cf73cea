"""Production compressor on the PyTorch device engine."""
