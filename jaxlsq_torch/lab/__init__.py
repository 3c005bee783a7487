"""Kernel labs: candidate kernel designs measured beside the shipped ones
(``int4_kernel_lab``)."""
