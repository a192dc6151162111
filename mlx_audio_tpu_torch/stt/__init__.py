"""Speech-to-text task package of the port."""
