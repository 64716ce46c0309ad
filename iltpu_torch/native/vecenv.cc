// Native vectorised MuJoCo environment stepper: the port's copy of
// native/vecenv.cc (the same code and C ABI, plus the calls for rendering
// at the end: scene and textures out, auto-reset off).
//
// The host half of the host-actor/device-learner split. Replaces the
// per-env Python loop of iltpu_torch/envs/host.py (and the reference's
// per-step Python<->C crossing, reference environments.py:35-40) with one
// C++ call per batched step that
//   - writes actions into N mjData, steps the physics on a persistent
//     thread pool (one batched call amortises language-boundary cost),
//   - computes Gym-v4 observations / rewards / terminations in C++
//     (semantics transcribed from gymnasium/envs/mujoco/{hopper,walker2d,
//     half_cheetah,ant}_v4.py — constants cited inline),
//   - auto-resets finished episodes and returns both the pre-reset
//     successor observation (for replay) and the post-reset observation
//     (for the next policy call),
//   - appends the DAC absorbing indicator bit (always 0 for live states;
//     reference environments.py:27,32,39) directly into the float32
//     output block, so Python does zero per-step array surgery.
// Rendering reads MuJoCo's abstract scene (mjv_updateScene, CPU code; no
// OpenGL) of one env and the model's textures: iltpu_torch/envs/render.py
// and iltpu_torch/utils/raycast.py turn them into pixels.
//
// Exposed as a C ABI consumed via ctypes (iltpu_torch/envs/native.py),
// built with g++ against the MuJoCo C library in third_party/mujoco.

#include <mujoco/mujoco.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

enum EnvType { HOPPER = 0, WALKER2D = 1, HALFCHEETAH = 2, ANT = 3 };

struct EnvInstance {
  mjData* data = nullptr;
  std::mt19937_64 rng;
  int steps_in_episode = 0;
};

struct VecEnv {
  mjModel* model = nullptr;
  EnvType type;
  int n_envs;
  int frame_skip;
  int time_limit;
  bool absorbing;
  int obs_base;  // obs size without the absorbing bit
  int torso_body = -1;
  bool auto_reset = true;  // off: a finished env keeps its last state (rendering)
  std::vector<double> init_qpos, init_qvel;
  // abstract scene for rendering, made at its first use (gymnasium's
  // MjvScene(model, max_geom=1000), default mjvOption and mjvPerturb)
  bool scene_made = false;
  mjvScene scene;
  mjvOption vopt;
  mjvPerturb pert;
  std::vector<EnvInstance> envs;

  // persistent thread pool (generation-counter barrier)
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  uint64_t generation = 0;
  int pending = 0;
  bool shutdown = false;
  // per-dispatch task state
  const float* actions = nullptr;
  float* next_obs = nullptr;
  float* rewards = nullptr;
  float* terminals = nullptr;
  float* timeouts = nullptr;
  float* obs_after = nullptr;

  ~VecEnv() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
      generation++;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    if (scene_made) mjv_freeScene(&scene);
    for (auto& e : envs)
      if (e.data) mj_deleteData(e.data);
    if (model) mj_deleteModel(model);
  }
};

int obs_base_size(const VecEnv* v) {
  const int nq = v->model->nq, nv = v->model->nv, nbody = v->model->nbody;
  switch (v->type) {
    case HOPPER:       // qpos[1:] + clip(qvel, +-10)    (hopper_v4.py:122-130)
    case WALKER2D:     // qpos[1:] + clip(qvel, +-10)    (walker2d_v4.py:114-122)
    case HALFCHEETAH:  // qpos[1:] + qvel                (half_cheetah_v4.py:100-108)
      return nq - 1 + nv;
    case ANT:  // qpos[2:] + qvel + clip(cfrc_ext, +-1)  (ant_v4.py:166-177)
      return nq - 2 + nv + 6 * nbody;
  }
  return 0;
}

// Write the env's Gym-v4 observation (float32) at out; appends the zero
// absorbing bit when enabled.
void write_obs(const VecEnv* v, const EnvInstance& e, float* out) {
  const mjData* d = e.data;
  const int nq = v->model->nq, nv = v->model->nv;
  int k = 0;
  switch (v->type) {
    case HOPPER:
    case WALKER2D:
      for (int i = 1; i < nq; i++) out[k++] = (float)d->qpos[i];
      for (int i = 0; i < nv; i++) {
        double q = d->qvel[i];
        out[k++] = (float)(q < -10 ? -10 : (q > 10 ? 10 : q));
      }
      break;
    case HALFCHEETAH:
      for (int i = 1; i < nq; i++) out[k++] = (float)d->qpos[i];
      for (int i = 0; i < nv; i++) out[k++] = (float)d->qvel[i];
      break;
    case ANT: {
      for (int i = 2; i < nq; i++) out[k++] = (float)d->qpos[i];
      for (int i = 0; i < nv; i++) out[k++] = (float)d->qvel[i];
      const int n = 6 * v->model->nbody;  // contact_force_range=(-1,1), ant_v4.py:101-105
      for (int i = 0; i < n; i++) {
        double c = d->cfrc_ext[i];
        out[k++] = (float)(c < -1 ? -1 : (c > 1 ? 1 : c));
      }
      break;
    }
  }
  if (v->absorbing) out[k++] = 0.0f;
}

bool is_healthy(const VecEnv* v, const EnvInstance& e) {
  const mjData* d = e.data;
  const int nq = v->model->nq, nv = v->model->nv;
  switch (v->type) {
    case HOPPER: {  // hopper_v4.py:99-113: z in (0.7, inf), angle in (-0.2, 0.2),
                    // all of state_vector()[2:] in (-100, 100)
      double z = d->qpos[1], angle = d->qpos[2];
      if (!(z > 0.7)) return false;
      if (!(angle > -0.2 && angle < 0.2)) return false;
      for (int i = 2; i < nq; i++)
        if (!(d->qpos[i] > -100.0 && d->qpos[i] < 100.0)) return false;
      for (int i = 0; i < nv; i++)
        if (!(d->qvel[i] > -100.0 && d->qvel[i] < 100.0)) return false;
      return true;
    }
    case WALKER2D: {  // walker2d_v4.py:97-107: z in (0.8, 2.0), angle in (-1, 1)
      double z = d->qpos[1], angle = d->qpos[2];
      return z > 0.8 && z < 2.0 && angle > -1.0 && angle < 1.0;
    }
    case HALFCHEETAH:  // never terminates (half_cheetah_v4.py:87)
      return true;
    case ANT: {  // ant_v4.py:115-119: all state finite and z in [0.2, 1.0]
      double z = d->qpos[2];
      if (!(z >= 0.2 && z <= 1.0)) return false;
      for (int i = 0; i < nq; i++)
        if (!std::isfinite(d->qpos[i])) return false;
      for (int i = 0; i < nv; i++)
        if (!std::isfinite(d->qvel[i])) return false;
      return true;
    }
  }
  return true;
}

void reset_env(VecEnv* v, EnvInstance& e) {
  mjData* d = e.data;
  const int nq = v->model->nq, nv = v->model->nv;
  mj_resetData(v->model, d);
  // Gym-v4 reset noise (hopper/walker2d: U(-5e-3, 5e-3) on qpos and qvel;
  // halfcheetah: U(-0.1, 0.1) qpos + 0.1*N(0,1) qvel;
  // ant: U(-0.1, 0.1) qpos + 0.1*N(0,1) qvel).
  double scale = (v->type == HOPPER || v->type == WALKER2D) ? 5e-3 : 0.1;
  std::uniform_real_distribution<double> unif(-scale, scale);
  std::normal_distribution<double> normal(0.0, 1.0);
  for (int i = 0; i < nq; i++) d->qpos[i] = v->init_qpos[i] + unif(e.rng);
  if (v->type == HOPPER || v->type == WALKER2D) {
    for (int i = 0; i < nv; i++) d->qvel[i] = v->init_qvel[i] + unif(e.rng);
  } else {
    for (int i = 0; i < nv; i++)
      d->qvel[i] = v->init_qvel[i] + scale * normal(e.rng);
  }
  mj_forward(v->model, d);
  e.steps_in_episode = 0;
}

void step_env(VecEnv* v, int i) {
  EnvInstance& e = v->envs[i];
  mjData* d = e.data;
  const int nu = v->model->nu;
  const double dt = v->model->opt.timestep * v->frame_skip;

  // Progress coordinate before stepping (ant uses the torso body frame x —
  // data.body("torso").xpos, ant_v4.py:127 + mujoco_env.py:165-167; others
  // use qpos[0]).
  double x_before = (v->type == ANT) ? d->xpos[3 * v->torso_body] : d->qpos[0];

  // Clip actions to ctrlrange (the adapter contract, reference
  // environments.py:36) and step.
  double ctrl_cost = 0.0;
  for (int j = 0; j < nu; j++) {
    double a = (double)v->actions[i * nu + j];
    double lo = v->model->actuator_ctrlrange[2 * j];
    double hi = v->model->actuator_ctrlrange[2 * j + 1];
    a = a < lo ? lo : (a > hi ? hi : a);
    d->ctrl[j] = a;
    ctrl_cost += a * a;
  }
  for (int s = 0; s < v->frame_skip; s++) mj_step(v->model, d);
  // Gym recomputes cfrc_ext post-step (mujoco_env.py:147-151); only ant
  // reads it (obs + contact cost), and it writes no dynamic state, so
  // skipping it elsewhere preserves exact trajectory parity.
  if (v->type == ANT) mj_rnePostConstraint(v->model, d);

  double x_after = (v->type == ANT) ? d->xpos[3 * v->torso_body] : d->qpos[0];
  double x_velocity = (x_after - x_before) / dt;

  bool healthy = is_healthy(v, e);
  double reward = 0.0;
  switch (v->type) {
    case HOPPER:    // 1.0 healthy + 1.0*x_vel - 1e-3*||a||^2 (hopper_v4.py:29-31,132-146)
    case WALKER2D:  // same weights (walker2d_v4.py:28-31,124-138)
      reward = 1.0 + x_velocity - 1e-3 * ctrl_cost;
      break;
    case HALFCHEETAH:  // 1.0*x_vel - 0.1*||a||^2 (half_cheetah_v4.py:28-29,75-87)
      reward = x_velocity - 0.1 * ctrl_cost;
      break;
    case ANT: {  // 1.0 healthy + x_vel - 0.5*||a||^2 - 5e-4*||clip(cfrc)||^2
                 // (ant_v4.py:26-29,126-161)
      double contact_cost = 0.0;
      const int n = 6 * v->model->nbody;
      for (int k = 0; k < n; k++) {
        double c = d->cfrc_ext[k];
        c = c < -1 ? -1 : (c > 1 ? 1 : c);
        contact_cost += c * c;
      }
      reward = 1.0 + x_velocity - 0.5 * ctrl_cost - 5e-4 * contact_cost;
      break;
    }
  }

  e.steps_in_episode++;
  bool terminated = !healthy && v->type != HALFCHEETAH;
  bool truncated = e.steps_in_episode >= v->time_limit;

  const int S = v->obs_base + (v->absorbing ? 1 : 0);
  write_obs(v, e, v->next_obs + (size_t)i * S);
  v->rewards[i] = (float)reward;
  // Timeout takes priority over terminal (reference train.py:157).
  v->terminals[i] = (terminated && !truncated) ? 1.0f : 0.0f;
  v->timeouts[i] = truncated ? 1.0f : 0.0f;

  if ((terminated || truncated) && v->auto_reset) {
    reset_env(v, e);
    write_obs(v, e, v->obs_after + (size_t)i * S);
  } else {
    std::memcpy(v->obs_after + (size_t)i * S, v->next_obs + (size_t)i * S,
                sizeof(float) * S);
  }
}

void worker_loop(VecEnv* v, int worker_id, int n_workers) {
  uint64_t seen = 0;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(v->mu);
      v->cv_work.wait(lk, [&] { return v->generation != seen || v->shutdown; });
      if (v->shutdown) return;
      seen = v->generation;
    }
    for (int i = worker_id; i < v->n_envs; i += n_workers) step_env(v, i);
    {
      std::lock_guard<std::mutex> lk(v->mu);
      if (--v->pending == 0) v->cv_done.notify_one();
    }
  }
}

}  // namespace

extern "C" {

void* vecenv_create(const char* xml_path, int env_type, int n_envs,
                    int frame_skip, int time_limit, int absorbing,
                    uint64_t seed, char* err, int err_len) {
  char load_err[512] = {0};
  mjModel* model = mj_loadXML(xml_path, nullptr, load_err, sizeof(load_err));
  if (!model) {
    std::snprintf(err, err_len, "mj_loadXML: %s", load_err);
    return nullptr;
  }
  auto* v = new VecEnv();
  v->model = model;
  v->type = (EnvType)env_type;
  v->n_envs = n_envs;
  v->frame_skip = frame_skip;
  v->time_limit = time_limit;
  v->absorbing = absorbing != 0;
  v->init_qpos.assign(model->qpos0, model->qpos0 + model->nq);
  v->init_qvel.assign(model->nv, 0.0);
  v->obs_base = obs_base_size(v);
  v->torso_body = mj_name2id(model, mjOBJ_BODY, "torso");
  if (v->type == ANT && v->torso_body < 0) {
    std::snprintf(err, err_len, "ant model has no torso body");
    delete v;
    return nullptr;
  }
  v->envs.resize(n_envs);
  for (int i = 0; i < n_envs; i++) {
    v->envs[i].data = mj_makeData(model);
    v->envs[i].rng.seed(seed + (uint64_t)i * 0x9E3779B97F4A7C15ull);
  }
  // Participants = spawned workers + the calling thread (which steps its
  // own slice in vecenv_step), so spawn hardware_concurrency - 1 threads.
  int participants = (int)std::thread::hardware_concurrency();
  if (participants > n_envs) participants = n_envs;
  if (participants < 1) participants = 1;
  for (int w = 0; w < participants - 1; w++)
    v->workers.emplace_back(worker_loop, v, w, participants);
  return v;
}

int vecenv_obs_size(void* h) {
  auto* v = (VecEnv*)h;
  return v->obs_base + (v->absorbing ? 1 : 0);
}

int vecenv_action_size(void* h) { return ((VecEnv*)h)->model->nu; }

double vecenv_dt(void* h) {
  auto* v = (VecEnv*)h;
  return v->model->opt.timestep * v->frame_skip;
}

void vecenv_reset(void* h, uint64_t seed, float* obs_out) {
  auto* v = (VecEnv*)h;
  const int S = vecenv_obs_size(h);
  for (int i = 0; i < v->n_envs; i++) {
    v->envs[i].rng.seed(seed + (uint64_t)i * 0x9E3779B97F4A7C15ull);
    reset_env(v, v->envs[i]);
    write_obs(v, v->envs[i], obs_out + (size_t)i * S);
  }
}

void vecenv_step(void* h, const float* actions, float* next_obs,
                 float* rewards, float* terminals, float* timeouts,
                 float* obs_after) {
  auto* v = (VecEnv*)h;
  v->actions = actions;
  v->next_obs = next_obs;
  v->rewards = rewards;
  v->terminals = terminals;
  v->timeouts = timeouts;
  v->obs_after = obs_after;
  // Tiny batches: the condition-variable handoff (~2 context switches)
  // costs more than the physics — step inline in the caller thread.
  if (v->n_envs == 1 || v->workers.empty()) {
    for (int i = 0; i < v->n_envs; i++) step_env(v, i);
    return;
  }
  {
    std::lock_guard<std::mutex> lk(v->mu);
    v->pending = (int)v->workers.size();
    v->generation++;
  }
  v->cv_work.notify_all();
  // The caller works its own slice instead of sleeping on the barrier —
  // on small hosts the calling core is a meaningful fraction of the
  // machine (participants = spawned workers + this thread).
  const int stride = (int)v->workers.size() + 1;
  for (int i = stride - 1; i < v->n_envs; i += stride) step_env(v, i);
  {
    std::unique_lock<std::mutex> lk(v->mu);
    v->cv_done.wait(lk, [&] { return v->pending == 0; });
  }
}

// Deterministic state injection for parity tests: set qpos/qvel of env i and
// recompute derived quantities (mj_forward), like gym's set_state.
void vecenv_set_state(void* h, int i, const double* qpos, const double* qvel) {
  auto* v = (VecEnv*)h;
  mjData* d = v->envs[i].data;
  std::memcpy(d->qpos, qpos, sizeof(double) * v->model->nq);
  std::memcpy(d->qvel, qvel, sizeof(double) * v->model->nv);
  mj_forward(v->model, d);
}

void vecenv_get_state(void* h, int i, double* qpos, double* qvel) {
  auto* v = (VecEnv*)h;
  mjData* d = v->envs[i].data;
  std::memcpy(qpos, d->qpos, sizeof(double) * v->model->nq);
  std::memcpy(qvel, d->qvel, sizeof(double) * v->model->nv);
}

// Off: a finished env is not reset, so its last state can still be drawn
// (gymnasium renders the step's state before any reset). obs_after is then
// the step's observation.
void vecenv_set_auto_reset(void* h, int on) { ((VecEnv*)h)->auto_reset = on != 0; }

// Env i's observation as it stands (after vecenv_set_state: gymnasium's
// reset observation), absorbing bit included.
void vecenv_obs(void* h, int i, float* out) {
  auto* v = (VecEnv*)h;
  write_obs(v, v->envs[i], out);
}

void vecenv_qpos0(void* h, double* out) {
  auto* v = (VecEnv*)h;
  std::memcpy(out, v->model->qpos0, sizeof(double) * v->model->nq);
}

// The model's sizes for rendering: ngeom, ntex, ntexdata, nmat, mjNTEXROLE,
// mjMAXLIGHT.
void vecenv_render_sizes(void* h, int64_t* out) {
  const mjModel* m = ((VecEnv*)h)->model;
  out[0] = m->ngeom;
  out[1] = m->ntex;
  out[2] = m->ntexdata;
  out[3] = m->nmat;
  out[4] = mjNTEXROLE;
  out[5] = mjMAXLIGHT;
}

// Env i's geom_xpos (ngeom x 3): where gymnasium's viewer looks at first.
void vecenv_geom_xpos(void* h, int i, double* out) {
  auto* v = (VecEnv*)h;
  std::memcpy(out, v->envs[i].data->geom_xpos, sizeof(double) * 3 * v->model->ngeom);
}

// The textures and materials (mjmodel.h:682-694): per texture (type,
// height, width, nchannel, adr), tex_data, mat_texid (nmat x mjNTEXROLE),
// mat_texrepeat (nmat x 2), mat_texuniform (nmat).
void vecenv_textures(void* h, int64_t* tex, uint8_t* data, int* mat_texid,
                     float* mat_texrepeat, int* mat_texuniform) {
  const mjModel* m = ((VecEnv*)h)->model;
  for (int t = 0; t < m->ntex; t++) {
    tex[5 * t + 0] = m->tex_type[t];
    tex[5 * t + 1] = m->tex_height[t];
    tex[5 * t + 2] = m->tex_width[t];
    tex[5 * t + 3] = m->tex_nchannel[t];
    tex[5 * t + 4] = m->tex_adr[t];
  }
  std::memcpy(data, m->tex_data, (size_t)m->ntexdata);
  std::memcpy(mat_texid, m->mat_texid, sizeof(int) * m->nmat * mjNTEXROLE);
  std::memcpy(mat_texrepeat, m->mat_texrepeat, sizeof(float) * 2 * m->nmat);
  for (int k = 0; k < m->nmat; k++) mat_texuniform[k] = m->mat_texuniform[k];
}

// mjv_updateScene on env i's mjData as it stands (no mj_forward: after a
// step the kinematics are those of the last substep's start, as gymnasium
// draws them), with mjCAT_ALL and the camera cam = (type, fixedcamid,
// trackbodyid, lookat[3], distance, azimuth, elevation, orthographic),
// which it may update in place. Copies out up to maxgeom geoms as rows of
// 25 floats (type, matid, size[3], pos[3], mat[9], rgba[4], emission,
// specular, shininess, reflectance), the lights as rows of 23 (pos[3],
// dir[3], type, castshadow, headlight, attenuation[3], cutoff, exponent,
// ambient[3], diffuse[3], specular[3]) and both GL cameras as rows of 16
// (pos[3], forward[3], up[3], frustum center, width, bottom, top, near,
// far, orthographic). Returns ngeom; *nlight is set.
int vecenv_scene(void* h, int i, double* cam, int maxgeom, float* geoms,
                 float* lights, int* nlight, float* cameras) {
  auto* v = (VecEnv*)h;
  if (!v->scene_made) {
    mjv_defaultScene(&v->scene);
    mjv_makeScene(v->model, &v->scene, 1000);
    mjv_defaultOption(&v->vopt);
    mjv_defaultPerturb(&v->pert);
    v->scene_made = true;
  }
  mjvCamera c;
  mjv_defaultCamera(&c);
  c.type = (int)cam[0];
  c.fixedcamid = (int)cam[1];
  c.trackbodyid = (int)cam[2];
  for (int k = 0; k < 3; k++) c.lookat[k] = cam[3 + k];
  c.distance = cam[6];
  c.azimuth = cam[7];
  c.elevation = cam[8];
  c.orthographic = (int)cam[9];
  mjvScene* s = &v->scene;
  mjv_updateScene(v->model, v->envs[i].data, &v->vopt, &v->pert, &c, mjCAT_ALL, s);
  cam[0] = c.type;
  cam[1] = c.fixedcamid;
  cam[2] = c.trackbodyid;
  for (int k = 0; k < 3; k++) cam[3 + k] = c.lookat[k];
  cam[6] = c.distance;
  cam[7] = c.azimuth;
  cam[8] = c.elevation;
  cam[9] = c.orthographic;
  const int n = s->ngeom < maxgeom ? s->ngeom : maxgeom;
  for (int g = 0; g < n; g++) {
    const mjvGeom& x = s->geoms[g];
    float* o = geoms + 25 * g;
    o[0] = (float)x.type;
    o[1] = (float)x.matid;
    std::memcpy(o + 2, x.size, sizeof(float) * 3);
    std::memcpy(o + 5, x.pos, sizeof(float) * 3);
    std::memcpy(o + 8, x.mat, sizeof(float) * 9);
    std::memcpy(o + 17, x.rgba, sizeof(float) * 4);
    o[21] = x.emission;
    o[22] = x.specular;
    o[23] = x.shininess;
    o[24] = x.reflectance;
  }
  for (int l = 0; l < s->nlight; l++) {
    const mjvLight& x = s->lights[l];
    float* o = lights + 23 * l;
    std::memcpy(o, x.pos, sizeof(float) * 3);
    std::memcpy(o + 3, x.dir, sizeof(float) * 3);
    o[6] = (float)x.type;
    o[7] = (float)x.castshadow;
    o[8] = (float)x.headlight;
    std::memcpy(o + 9, x.attenuation, sizeof(float) * 3);
    o[12] = x.cutoff;
    o[13] = x.exponent;
    std::memcpy(o + 14, x.ambient, sizeof(float) * 3);
    std::memcpy(o + 17, x.diffuse, sizeof(float) * 3);
    std::memcpy(o + 20, x.specular, sizeof(float) * 3);
  }
  *nlight = s->nlight;
  for (int k = 0; k < 2; k++) {
    const mjvGLCamera& x = s->camera[k];
    float* o = cameras + 16 * k;
    std::memcpy(o, x.pos, sizeof(float) * 3);
    std::memcpy(o + 3, x.forward, sizeof(float) * 3);
    std::memcpy(o + 6, x.up, sizeof(float) * 3);
    o[9] = x.frustum_center;
    o[10] = x.frustum_width;
    o[11] = x.frustum_bottom;
    o[12] = x.frustum_top;
    o[13] = x.frustum_near;
    o[14] = x.frustum_far;
    o[15] = (float)x.orthographic;
  }
  return s->ngeom;
}

void vecenv_destroy(void* h) { delete (VecEnv*)h; }

}  // extern "C"
