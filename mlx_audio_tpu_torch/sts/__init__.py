"""Speech-to-speech task package of the port."""
