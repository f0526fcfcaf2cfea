"""ROS2 nav_msgs/Odometry localization plugin (optional dependency: rclpy).

Behavioral parity with the reference plugin (dial_mpc/deploy/localization/
ros2_odometry_plugin.py:11-65): subscribe to an odometry topic and convert
the body-frame twist to world frame. One deliberate fix: the reference
passed a wxyz quaternion to scipy's xyzw-ordered ``Rotation.from_quat``;
we pass the correct order.
"""

import numpy as np
from scipy.spatial.transform import Rotation as R

import rclpy
from rclpy.node import Node
from nav_msgs.msg import Odometry

from dial_mpc_tpu_torch.deploy.localization.base_plugin import BaseLocalizationPlugin


class ROS2OdometryPlugin(BaseLocalizationPlugin, Node):
    def __init__(self, config):
        BaseLocalizationPlugin.__init__(self, config)
        rclpy.init()
        Node.__init__(self, "ros2_odom_plugin")
        self.subscription = self.create_subscription(
            Odometry, config["odom_topic"], self.odom_callback, 1
        )
        self.qpos = None
        self.qvel = None
        self.last_time = None

    def __del__(self):
        rclpy.shutdown()

    def odom_callback(self, msg):
        p = msg.pose.pose.position
        o = msg.pose.pose.orientation
        qpos = np.array([p.x, p.y, p.z, o.w, o.x, o.y, o.z])
        vb = np.array(
            [msg.twist.twist.linear.x, msg.twist.twist.linear.y, msg.twist.twist.linear.z]
        )
        ab = np.array(
            [
                msg.twist.twist.angular.x,
                msg.twist.twist.angular.y,
                msg.twist.twist.angular.z,
            ]
        )
        rot = R.from_quat([o.x, o.y, o.z, o.w])  # scipy expects xyzw
        self.qpos = qpos
        self.qvel = np.concatenate([rot.apply(vb), rot.apply(ab)])
        self.last_time = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9

    def get_state(self):
        if self.qpos is None:
            return None
        return np.concatenate([self.qpos, self.qvel])

    def get_last_update_time(self):
        return self.last_time
