"""The benchmark's machinery: the manifest, the weights and inputs made from
the seed, what every traffic loop shares, the profiler slice, the
arithmetic of rooflines and MFU, and the comparison that decides `correct`."""
