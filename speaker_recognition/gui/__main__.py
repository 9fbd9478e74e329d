"""`python -m speaker_recognition.gui` — launch the web GUI."""

from .server import main

main()
