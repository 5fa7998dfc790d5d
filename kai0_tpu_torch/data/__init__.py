"""Dataset readers of the port: LeRobot metadata and episodes, and the transformed view the loader reads."""
