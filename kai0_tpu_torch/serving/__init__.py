"""The websocket policy server over the port's Policy."""
