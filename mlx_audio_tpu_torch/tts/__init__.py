"""Text-to-speech task package of the port."""
