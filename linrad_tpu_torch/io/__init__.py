"""Ingest/output harness replacing Linrad's hardware, soundcard and GUI
layers: recorded-IQ files, synthetic generators, audio writers."""
