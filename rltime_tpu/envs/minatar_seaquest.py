"""MinAtar-style device-resident Seaquest — the 5th (and most complex)
game of the published MinAtar suite (Young & Tian 2019,
arXiv:1903.03176), completing the family next to Breakout
(envs/minatar.py) and Asterix/Freeway/Space Invaders
(envs/minatar_games.py). Same design rationale as those modules: pure
vectorized jnp dynamics so the full image-obs pipeline (CNN torso,
replay, PER, IQN/R2D2) trains with ZERO host involvement — the
Device-resident stand-in for the reference's ALE validation workloads
(SURVEY.md §0 items 1, 4).

Game: the player submarine (6 actions: noop/left/up/right/down/fire)
shoots enemy fish and enemy submarines (+1 each), collects divers, and
must resurface before oxygen runs out. Surfacing with no divers is
death; with 1-5 divers costs one diver and refills oxygen; with all 6
cashes in a bonus of ``oxygen * 10 // 200`` and ramps difficulty
(enemy spawn interval down every cash-in, enemy move interval every
other). Enemy submarines fire bullets; contact with any enemy or
bullet is terminal. Row 9 is the instrument row (oxygen + diver
gauges); the sub moves in rows 0-8, row 0 being the surface.

Dynamics are the best reconstruction of the published game (the
MinAtar package is not installable in-sandbox to diff against); the
vectorization is golden-tested lane-by-lane against an INDEPENDENT
scalar Python model in tests/test_minatar_seaquest.py. Documented
deviations from the (unverifiable) upstream, chosen to keep the step
jit-safe with fixed shapes:

  * Entity lists are fixed slot arrays (16 fish, 16 enemy subs,
    24 enemy bullets, 8 divers, 4 friendly bullets); a spawn/shot is
    skipped when its family is full. The caps are sized so random and
    trained play essentially never hit them.
  * A friendly bullet kills EVERY enemy on its landing cell (upstream
    kills the first list entry); coincident enemies are measure-zero.
  * Diver pickups resolve in slot order under the 6-diver cap.

Shared MinAtar conventions (see envs/minatar.py): (10, 10, C) binary
uint8 planes, no frame stack (trail channel = one-step motion memory),
sticky actions p=0.1, auto-reset, configurable time-limit truncation.
Channels: 0 sub_front, 1 sub_back, 2 friendly_bullet, 3 trail (fish +
enemy subs), 4 enemy_bullet, 5 enemy_fish, 6 enemy_sub,
7 oxygen_gauge, 8 diver_gauge, 9 diver.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_OXYGEN = 200
INIT_SPAWN_SPEED = 20
DIVER_SPAWN_SPEED = 30
INIT_MOVE_INTERVAL = 5
SHOT_COOL_DOWN = 5
ENEMY_SHOT_INTERVAL = 10
DIVER_MOVE_INTERVAL = 5

N_FISH = 16
N_ESUB = 16
N_EBUL = 24
N_FBUL = 4
N_DIV = 8


def _const(E: int, v) -> jnp.ndarray:
    """Distinct numpy-backed per-lane int32 constant (donation rules —
    see envs/minatar_games._const)."""
    return jnp.asarray(np.full((E,), v, np.int32))


def _slots(E: int, n: int, dtype=jnp.int32) -> jnp.ndarray:
    if dtype is jnp.bool_:
        return jnp.asarray(np.zeros((E, n), np.bool_))
    return jnp.asarray(np.zeros((E, n), np.int32))


class SeaquestState(NamedTuple):
    sub_x: jnp.ndarray        # (E,) int32 in [0, 9]
    sub_y: jnp.ndarray        # (E,) int32 in [0, 8] (9 = gauge row)
    sub_or: jnp.ndarray       # (E,) bool, True = facing right
    shot_timer: jnp.ndarray   # (E,) player fire cooldown
    oxygen: jnp.ndarray       # (E,) int32
    diver_count: jnp.ndarray  # (E,) int32 in [0, 6]
    surface: jnp.ndarray      # (E,) bool — at surface since last dive
    fb_x: jnp.ndarray         # (E, 4) friendly bullets
    fb_y: jnp.ndarray
    fb_right: jnp.ndarray
    fb_alive: jnp.ndarray
    fish_x: jnp.ndarray       # (E, 16) enemy fish
    fish_y: jnp.ndarray
    fish_right: jnp.ndarray
    fish_t: jnp.ndarray       # move countdown
    fish_alive: jnp.ndarray
    es_x: jnp.ndarray         # (E, 16) enemy submarines
    es_y: jnp.ndarray
    es_right: jnp.ndarray
    es_t: jnp.ndarray         # move countdown
    es_shot_t: jnp.ndarray    # fire countdown
    es_alive: jnp.ndarray
    eb_x: jnp.ndarray         # (E, 24) enemy bullets
    eb_y: jnp.ndarray
    eb_right: jnp.ndarray
    eb_alive: jnp.ndarray
    div_x: jnp.ndarray        # (E, 8) divers
    div_y: jnp.ndarray
    div_right: jnp.ndarray
    div_t: jnp.ndarray        # move countdown
    div_alive: jnp.ndarray
    e_spawn_speed: jnp.ndarray  # (E,) ramps down on 6-diver cash-in
    e_spawn_timer: jnp.ndarray
    d_spawn_timer: jnp.ndarray
    move_speed: jnp.ndarray     # (E,) enemy move interval (ramped)
    ramp_index: jnp.ndarray
    last_action: jnp.ndarray
    steps: jnp.ndarray
    key: jnp.ndarray
    # test hooks: this step's spawn draws (valid iff *_spawned)
    dbg_e_spawned: jnp.ndarray  # (E,) bool
    dbg_e_lr: jnp.ndarray       # (E,) bool (True = spawned left, moves right)
    dbg_e_row: jnp.ndarray      # (E,) int32
    dbg_e_sub: jnp.ndarray      # (E,) bool (enemy sub vs fish)
    dbg_d_spawned: jnp.ndarray  # (E,) bool
    dbg_d_lr: jnp.ndarray       # (E,) bool
    dbg_d_row: jnp.ndarray      # (E,) int32


def _seaquest_fresh(E: int) -> dict:
    b = jnp.bool_
    return dict(
        sub_x=_const(E, 5), sub_y=_const(E, 0),
        sub_or=jnp.asarray(np.zeros((E,), np.bool_)),
        shot_timer=_const(E, 0), oxygen=_const(E, MAX_OXYGEN),
        diver_count=_const(E, 0),
        surface=jnp.asarray(np.ones((E,), np.bool_)),
        fb_x=_slots(E, N_FBUL), fb_y=_slots(E, N_FBUL),
        fb_right=_slots(E, N_FBUL, b), fb_alive=_slots(E, N_FBUL, b),
        fish_x=_slots(E, N_FISH), fish_y=_slots(E, N_FISH),
        fish_right=_slots(E, N_FISH, b), fish_t=_slots(E, N_FISH),
        fish_alive=_slots(E, N_FISH, b),
        es_x=_slots(E, N_ESUB), es_y=_slots(E, N_ESUB),
        es_right=_slots(E, N_ESUB, b), es_t=_slots(E, N_ESUB),
        es_shot_t=_slots(E, N_ESUB), es_alive=_slots(E, N_ESUB, b),
        eb_x=_slots(E, N_EBUL), eb_y=_slots(E, N_EBUL),
        eb_right=_slots(E, N_EBUL, b), eb_alive=_slots(E, N_EBUL, b),
        div_x=_slots(E, N_DIV), div_y=_slots(E, N_DIV),
        div_right=_slots(E, N_DIV, b), div_t=_slots(E, N_DIV),
        div_alive=_slots(E, N_DIV, b),
        e_spawn_speed=_const(E, INIT_SPAWN_SPEED),
        e_spawn_timer=_const(E, INIT_SPAWN_SPEED),
        d_spawn_timer=_const(E, DIVER_SPAWN_SPEED),
        move_speed=_const(E, INIT_MOVE_INTERVAL),
        ramp_index=_const(E, 0),
        last_action=_const(E, 0), steps=_const(E, 0),
    )


def _first_free(free: jnp.ndarray) -> jnp.ndarray:
    """(E, N) bool -> (E,) index of the first True (0 if none)."""
    return jnp.argmax(free, axis=1).astype(jnp.int32)


class DeviceSeaquest:
    """Vectorized MinAtar-style Seaquest; all methods jit-safe.

    Actions: 0 no-op, 1 left, 2 up, 3 right, 4 down, 5 fire (the
    game's full MinAtar action set — all six are meaningful here).
    """

    num_actions = 6
    obs_shape = (10, 10, 10)
    obs_dtype = jnp.uint8

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000,
                 ramping: bool = True):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit
        self.ramping = ramping

    def reset(self, key, num_envs: int) -> SeaquestState:
        E = num_envs
        return SeaquestState(
            key=key,
            dbg_e_spawned=jnp.zeros((E,), jnp.bool_),
            dbg_e_lr=jnp.zeros((E,), jnp.bool_),
            dbg_e_row=_const(E, 1),
            dbg_e_sub=jnp.zeros((E,), jnp.bool_),
            dbg_d_spawned=jnp.zeros((E,), jnp.bool_),
            dbg_d_lr=jnp.zeros((E,), jnp.bool_),
            dbg_d_row=_const(E, 1),
            **_seaquest_fresh(E))

    def observe(self, state: SeaquestState) -> jnp.ndarray:
        E = state.sub_x.shape[0]
        lanes = jnp.arange(E)
        l2 = lanes[:, None]
        cols = jnp.arange(10)
        obs = jnp.zeros((E, 10, 10, 10), jnp.uint8)
        obs = obs.at[lanes, state.sub_y, state.sub_x, 0].set(1)
        # back cell dropped when off-board (same rule as trail();
        # unreachable in play — facing right implies x >= 1 — but kept
        # exact for constructed states)
        back_x = jnp.where(state.sub_or, state.sub_x - 1,
                           state.sub_x + 1)
        back_ok = ((back_x >= 0) & (back_x <= 9)).astype(jnp.uint8)
        obs = obs.at[lanes, state.sub_y, jnp.clip(back_x, 0, 9),
                     1].max(back_ok)
        obs = obs.at[l2, state.fb_y, state.fb_x, 2].max(
            state.fb_alive.astype(jnp.uint8))

        def trail(x, right, alive):
            bx = jnp.where(right, x - 1, x + 1)
            ok = alive & (bx >= 0) & (bx <= 9)
            return jnp.clip(bx, 0, 9), ok.astype(jnp.uint8)

        fbx, fok = trail(state.fish_x, state.fish_right, state.fish_alive)
        obs = obs.at[l2, state.fish_y, fbx, 3].max(fok)
        sbx, sok = trail(state.es_x, state.es_right, state.es_alive)
        obs = obs.at[l2, state.es_y, sbx, 3].max(sok)
        obs = obs.at[l2, state.eb_y, state.eb_x, 4].max(
            state.eb_alive.astype(jnp.uint8))
        obs = obs.at[l2, state.fish_y, state.fish_x, 5].max(
            state.fish_alive.astype(jnp.uint8))
        obs = obs.at[l2, state.es_y, state.es_x, 6].max(
            state.es_alive.astype(jnp.uint8))
        oxy_cells = (state.oxygen * 10) // MAX_OXYGEN      # (E,)
        obs = obs.at[:, 9, :, 7].set(
            (cols[None, :] < oxy_cells[:, None]).astype(jnp.uint8))
        obs = obs.at[:, 9, :, 8].set(
            ((cols[None, :] >= 9 - state.diver_count[:, None])
             & (cols[None, :] < 9)).astype(jnp.uint8))
        obs = obs.at[l2, state.div_y, state.div_x, 9].max(
            state.div_alive.astype(jnp.uint8))
        return obs

    def step(self, state: SeaquestState, actions: jnp.ndarray):
        E = actions.shape[0]
        (key, k_sticky, k_elr, k_erow, k_esub, k_dlr,
         k_drow) = jax.random.split(state.key, 7)

        a = actions.astype(jnp.int32)
        if self.sticky_prob > 0:
            stick = jax.random.bernoulli(k_sticky, self.sticky_prob, (E,))
            a = jnp.where(stick, state.last_action, a)

        # 1) enemy spawn on timer expiry: side ~ U{L,R}, row ~ U[1,8],
        #    enemy sub with p=1/3; first free slot of the family
        e_lr = jax.random.bernoulli(k_elr, 0.5, (E,))
        e_row = jax.random.randint(k_erow, (E,), 1, 9)
        e_is_sub = jax.random.uniform(k_esub, (E,)) < (1.0 / 3.0)
        timer_up = state.e_spawn_timer == 0
        free_fish = ~state.fish_alive
        free_es = ~state.es_alive
        fam_free = jnp.where(e_is_sub, jnp.any(free_es, 1),
                             jnp.any(free_fish, 1))
        e_spawned = timer_up & fam_free
        sx = jnp.where(e_lr, 0, 9).astype(jnp.int32)

        put_f = (jax.nn.one_hot(_first_free(free_fish), N_FISH,
                                dtype=jnp.bool_)
                 & (e_spawned & ~e_is_sub)[:, None])
        fish_x = jnp.where(put_f, sx[:, None], state.fish_x)
        fish_y = jnp.where(put_f, e_row[:, None], state.fish_y)
        fish_right = jnp.where(put_f, e_lr[:, None], state.fish_right)
        fish_t = jnp.where(put_f, state.move_speed[:, None], state.fish_t)
        fish_alive = state.fish_alive | put_f

        put_s = (jax.nn.one_hot(_first_free(free_es), N_ESUB,
                                dtype=jnp.bool_)
                 & (e_spawned & e_is_sub)[:, None])
        es_x = jnp.where(put_s, sx[:, None], state.es_x)
        es_y = jnp.where(put_s, e_row[:, None], state.es_y)
        es_right = jnp.where(put_s, e_lr[:, None], state.es_right)
        es_t = jnp.where(put_s, state.move_speed[:, None], state.es_t)
        es_shot_t = jnp.where(put_s, ENEMY_SHOT_INTERVAL, state.es_shot_t)
        es_alive = state.es_alive | put_s
        e_spawn_timer = jnp.where(timer_up, state.e_spawn_speed,
                                  state.e_spawn_timer)

        # 2) diver spawn on timer expiry: side ~ U{L,R}, row ~ U[1,8]
        d_lr = jax.random.bernoulli(k_dlr, 0.5, (E,))
        d_row = jax.random.randint(k_drow, (E,), 1, 9)
        d_up = state.d_spawn_timer == 0
        free_d = ~state.div_alive
        d_spawned = d_up & jnp.any(free_d, 1)
        put_d = (jax.nn.one_hot(_first_free(free_d), N_DIV,
                                dtype=jnp.bool_) & d_spawned[:, None])
        div_x = jnp.where(put_d, jnp.where(d_lr, 0, 9)[:, None],
                          state.div_x)
        div_y = jnp.where(put_d, d_row[:, None], state.div_y)
        div_right = jnp.where(put_d, d_lr[:, None], state.div_right)
        div_t = jnp.where(put_d, DIVER_MOVE_INTERVAL, state.div_t)
        div_alive = state.div_alive | put_d
        d_spawn_timer = jnp.where(d_up, DIVER_SPAWN_SPEED,
                                  state.d_spawn_timer)

        # 3) action: fire (on cooldown) from the CURRENT cell, else move
        fire = (a == 5) & (state.shot_timer == 0)
        free_fb = ~state.fb_alive
        can_fire = fire & jnp.any(free_fb, 1)
        put_b = (jax.nn.one_hot(_first_free(free_fb), N_FBUL,
                                dtype=jnp.bool_) & can_fire[:, None])
        fb_x = jnp.where(put_b, state.sub_x[:, None], state.fb_x)
        fb_y = jnp.where(put_b, state.sub_y[:, None], state.fb_y)
        fb_right = jnp.where(put_b, state.sub_or[:, None], state.fb_right)
        fb_alive = state.fb_alive | put_b
        shot_timer = jnp.where(fire, SHOT_COOL_DOWN, state.shot_timer)
        sub_x = jnp.clip(state.sub_x - (a == 1) + (a == 3), 0, 9)
        sub_y = jnp.clip(state.sub_y - (a == 2) + (a == 4), 0, 8)
        sub_or = jnp.where(a == 1, False,
                           jnp.where(a == 3, True, state.sub_or))

        # 4) friendly bullets: move, die off-board, kill every enemy on
        #    the landing cell (+1 each; see module docstring)
        fbx2 = fb_x + jnp.where(fb_right, 1, -1)
        fb_off = (fbx2 < 0) | (fbx2 > 9)
        fb_live = fb_alive & ~fb_off
        hit_f = (fb_live[:, :, None] & fish_alive[:, None, :]
                 & (fbx2[:, :, None] == fish_x[:, None, :])
                 & (fb_y[:, :, None] == fish_y[:, None, :]))
        hit_s = (fb_live[:, :, None] & es_alive[:, None, :]
                 & (fbx2[:, :, None] == es_x[:, None, :])
                 & (fb_y[:, :, None] == es_y[:, None, :]))
        fish_killed = jnp.any(hit_f, axis=1)
        es_killed = jnp.any(hit_s, axis=1)
        bullet_hit = jnp.any(hit_f, 2) | jnp.any(hit_s, 2)
        reward = (jnp.sum(fish_killed, 1)
                  + jnp.sum(es_killed, 1)).astype(jnp.float32)
        fb_alive = fb_live & ~bullet_hit
        fb_x = jnp.clip(fbx2, 0, 9)
        fish_alive = fish_alive & ~fish_killed
        es_alive = es_alive & ~es_killed

        # 5) divers: pickup-if-on-sub, else move on timer (+pickup),
        #    slot order under the 6-diver cap (sequential capacity)
        count = state.diver_count
        dx_cols, dt_cols, da_cols = [], [], []
        for i in range(N_DIV):
            al = div_alive[:, i]
            x, y = div_x[:, i], div_y[:, i]
            rgt, tm = div_right[:, i], div_t[:, i]
            on_pre = al & (x == sub_x) & (y == sub_y) & (count < 6)
            t0 = tm == 0
            mv = al & ~on_pre & t0
            x2 = x + jnp.where(rgt, 1, -1)
            off = (x2 < 0) | (x2 > 9)
            on_post = (mv & ~off & (x2 == sub_x) & (y == sub_y)
                       & (count < 6))
            picked = on_pre | on_post
            count = count + picked
            da_cols.append(al & ~picked & ~(mv & off))
            dx_cols.append(jnp.where(mv, jnp.clip(x2, 0, 9), x))
            dt_cols.append(jnp.where(mv, DIVER_MOVE_INTERVAL,
                                     jnp.where(al & ~on_pre & ~t0,
                                               tm - 1, tm)))
        div_x = jnp.stack(dx_cols, axis=1)
        div_t = jnp.stack(dt_cols, axis=1)
        div_alive = jnp.stack(da_cols, axis=1)
        diver_count = count

        # 6) enemy fish: contact kills the player (checked every step
        #    AND after their own move on timer expiry)
        def march(x, y, right, t, alive):
            pre = alive & (x == sub_x[:, None]) & (y == sub_y[:, None])
            t0 = t == 0
            mv = alive & t0
            x2 = x + jnp.where(right, 1, -1)
            off = (x2 < 0) | (x2 > 9)
            post = (mv & ~off & (x2 == sub_x[:, None])
                    & (y == sub_y[:, None]))
            alive2 = alive & ~(mv & off)
            x_new = jnp.where(mv, jnp.clip(x2, 0, 9), x)
            t_new = jnp.where(mv, state.move_speed[:, None],
                              jnp.where(alive & ~t0, t - 1, t))
            died = jnp.any(pre | post, axis=1)
            return x_new, t_new, alive2, died

        fish_x, fish_t, fish_alive, die_f = march(
            fish_x, fish_y, fish_right, fish_t, fish_alive)

        # 7) enemy subs: march like fish, then fire on their own timer
        #    from the post-move cell (first free bullet slot)
        es_x, es_t, es_alive, die_s = march(
            es_x, es_y, es_right, es_t, es_alive)
        eb_x, eb_y = state.eb_x, state.eb_y
        eb_right, eb_alive = state.eb_right, state.eb_alive
        eb_free = ~eb_alive
        shot_cols = []
        for j in range(N_ESUB):
            shoot = es_alive[:, j] & (es_shot_t[:, j] == 0)
            can = shoot & jnp.any(eb_free, 1)
            oh = (jax.nn.one_hot(_first_free(eb_free), N_EBUL,
                                 dtype=jnp.bool_) & can[:, None])
            eb_x = jnp.where(oh, es_x[:, j, None], eb_x)
            eb_y = jnp.where(oh, es_y[:, j, None], eb_y)
            eb_right = jnp.where(oh, es_right[:, j, None], eb_right)
            eb_alive = eb_alive | oh
            eb_free = eb_free & ~oh
            shot_cols.append(jnp.where(shoot, ENEMY_SHOT_INTERVAL,
                                       jnp.where(es_alive[:, j],
                                                 es_shot_t[:, j] - 1,
                                                 es_shot_t[:, j])))
        es_shot_t = jnp.stack(shot_cols, axis=1)

        # 8) enemy bullets (incl. ones just fired): contact pre- and
        #    post-move is terminal; move every step
        pre_hit = (eb_alive & (eb_x == sub_x[:, None])
                   & (eb_y == sub_y[:, None]))
        ebx2 = eb_x + jnp.where(eb_right, 1, -1)
        eb_off = (ebx2 < 0) | (ebx2 > 9)
        post_hit = (eb_alive & ~eb_off & (ebx2 == sub_x[:, None])
                    & (eb_y == sub_y[:, None]))
        die_b = jnp.any(pre_hit | post_hit, axis=1)
        eb_alive = eb_alive & ~eb_off
        eb_x = jnp.clip(ebx2, 0, 9)

        # 9) guarded timer decrements
        e_spawn_timer = jnp.where(e_spawn_timer > 0, e_spawn_timer - 1,
                                  e_spawn_timer)
        d_spawn_timer = jnp.where(d_spawn_timer > 0, d_spawn_timer - 1,
                                  d_spawn_timer)
        shot_timer = jnp.where(shot_timer > 0, shot_timer - 1,
                               shot_timer)

        # 10) oxygen / surfacing
        submerged = sub_y > 0
        oxygen = jnp.where(submerged, state.oxygen - 1, state.oxygen)
        oxy_dead = submerged & (oxygen < 0)
        surfacing = (~submerged) & (~state.surface)
        surf_dead = surfacing & (diver_count == 0)
        cash = surfacing & (diver_count == 6)
        partial = surfacing & (diver_count > 0) & (diver_count < 6)
        reward = reward + jnp.where(
            cash, (oxygen * 10) // MAX_OXYGEN, 0).astype(jnp.float32)
        e_spawn_speed, move_speed = state.e_spawn_speed, state.move_speed
        ramp_index = state.ramp_index
        if self.ramping:
            do_ramp = cash & ((e_spawn_speed > 1) | (move_speed > 2))
            move_speed = jnp.where(
                do_ramp & (move_speed > 2) & (ramp_index % 2 == 1),
                move_speed - 1, move_speed)
            e_spawn_speed = jnp.where(do_ramp & (e_spawn_speed > 1),
                                      e_spawn_speed - 1, e_spawn_speed)
            ramp_index = ramp_index + do_ramp.astype(jnp.int32)
        diver_count = jnp.where(cash, 0,
                                jnp.where(partial, diver_count - 1,
                                          diver_count))
        oxygen = jnp.where(surfacing & ~surf_dead, MAX_OXYGEN, oxygen)
        surface = ~submerged

        terminated = die_f | die_s | die_b | oxy_dead | surf_dead
        steps = state.steps + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        fresh = _seaquest_fresh(E)
        cur = dict(sub_x=sub_x, sub_y=sub_y, sub_or=sub_or,
                   shot_timer=shot_timer, oxygen=oxygen,
                   diver_count=diver_count, surface=surface,
                   fb_x=fb_x, fb_y=fb_y, fb_right=fb_right,
                   fb_alive=fb_alive,
                   fish_x=fish_x, fish_y=fish_y, fish_right=fish_right,
                   fish_t=fish_t, fish_alive=fish_alive,
                   es_x=es_x, es_y=es_y, es_right=es_right, es_t=es_t,
                   es_shot_t=es_shot_t, es_alive=es_alive,
                   eb_x=eb_x, eb_y=eb_y, eb_right=eb_right,
                   eb_alive=eb_alive,
                   div_x=div_x, div_y=div_y, div_right=div_right,
                   div_t=div_t, div_alive=div_alive,
                   e_spawn_speed=e_spawn_speed,
                   e_spawn_timer=e_spawn_timer,
                   d_spawn_timer=d_spawn_timer, move_speed=move_speed,
                   ramp_index=ramp_index, last_action=a, steps=steps)

        def pick(f, c):
            m = done.reshape((E,) + (1,) * (c.ndim - 1))
            return jnp.where(m, f, c)

        new_state = SeaquestState(
            key=key,
            dbg_e_spawned=e_spawned, dbg_e_lr=e_lr, dbg_e_row=e_row,
            dbg_e_sub=e_is_sub,
            dbg_d_spawned=d_spawned, dbg_d_lr=d_lr, dbg_d_row=d_row,
            **{k: pick(fresh[k], cur[k]) for k in cur})
        return new_state, reward, terminated, truncated
