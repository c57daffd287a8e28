"""Host components built from the package's C++ sources (``csrc/``) and
bound with ctypes: the WAV reader and writer."""
