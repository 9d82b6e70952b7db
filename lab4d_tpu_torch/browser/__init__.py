"""The port's result browser (app.py)."""
