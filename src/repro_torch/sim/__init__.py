"""PIM timing model the serving engine observes (port's copy)."""
