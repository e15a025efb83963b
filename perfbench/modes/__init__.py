"""One driver per traffic mode: build, window, free, check, end_to_end."""
