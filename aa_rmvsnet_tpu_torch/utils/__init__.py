"""Run configuration presets and device handling."""
