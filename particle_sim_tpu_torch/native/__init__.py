"""Native host code: the frame packer (packer.cpp) and its build."""
