"""Welch PSD scanning, scan-peak picking and sonde-type detection by
template correlation."""
